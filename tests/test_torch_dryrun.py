"""The port's dry-run (`repro_torch.launch.specs`, `launch.dryrun`,
`roofline.analysis`, `roofline.graph_parse`, `roofline.report`) against the
JAX package's, on the CPU, on torch's ``fake`` process groups.

- `input_specs` against the reference's for every config, shape and
  production mesh: shapes, dtypes and ``PartitionSpec``s, leaf by leaf (the
  reference on a mesh of one repeated CPU device, as
  tests/test_torch_sharding.py builds it);
- the graph parser's conventions on hand-built graphs (the counterpart of
  tests/test_sharding_and_roofline.py's TestHloParser);
- `run_cells`' records (ok for prefill, decode and train, a skipped
  long_500k cell, an error) and their keys and file names, and the
  report's tables from them;
- the train cells' own pieces: a `NamedTuple` state through `_leaves` /
  `_rebuild`, ``alias_bytes`` (the donated state's local bytes; 0 for a
  prefill), ``--microbatches 2`` counting the FLOPs of 1, and
  ``--moments-dtype bfloat16`` halving the moments' argument bytes;
- one cell against the reference's own `lower_cell`, run in a subprocess
  that forces 512 host devices before importing JAX: smollm-135m at full
  width cut to 2 layers (registered on both sides), prefill_32k and
  train_4k on the 16 x 16 mesh. `model_flops` must be equal and the
  per-chip product FLOPs within 10% of the reference's dots (the limit
  and its reasoning are in PERF.md, §6, under the dry-run slice and,
  for the train cell, under the train cells' slice).

- olmo-1b's full-size decode_32k cell against the hand count of
  tests/test_torch_dryrun_cells.py, which holds the prefill_32k cell.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.fx.experimental.proxy_tensor import make_fx

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models import make_model as jax_make_model
from repro.sharding import rules as JR
from repro_torch import tree
from repro_torch.configs import SHAPES, base, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import make_model
from repro_torch.roofline import report
from repro_torch.roofline.analysis import HW_H100, RooflineReport, model_flops
from repro_torch.roofline.graph_parse import analyze_graph_module
from repro_torch.sharding.rules import DECODE_RULES, TRAIN_RULES, ShardingRules
from dryrun_reference_compare import REFERENCE
from test_torch_dryrun_cells import check as check_hand_count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(jax_all_configs())
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
REPORT_KEYS = set(RooflineReport.__dataclass_fields__) | {
    "lower_s", "compile_s", "microbatches", "param_count", "active_param_count"}


@pytest.fixture
def fake_group():
    """`start(world)`: this process as rank 0 of a ``fake`` group of
    `world` ranks; destroyed at teardown."""
    def start(world: int) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        dryrun.start_fake_group(world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Input specs
# --------------------------------------------------------------------------- #
def port_spec(t) -> tuple:
    """A port leaf's layout as the reference's PartitionSpec tuple: per
    tensor dim, the mesh axes (in mesh order) that split it."""
    if not isinstance(t, DTensor):
        return None
    names = t.device_mesh.mesh_dim_names
    out = []
    for d in range(t.ndim):
        axes = tuple(names[m] for m, p in enumerate(t.placements)
                     if isinstance(p, Shard) and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def port_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(port_leaves(getattr(tree, f.name), f"{prefix}.{f.name}"))
        return out
    if isinstance(tree, torch.Tensor):
        dtype = str(tree.dtype).replace("torch.", "")
        return {prefix: (tuple(tree.shape), dtype, port_spec(tree))}
    return {}     # a cache's host-side length


def jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        if name.endswith(".length"):
            continue
        spec = None if leaf.sharding is None else tuple(leaf.sharding.spec) + (None,) * (
            len(leaf.shape) - len(leaf.sharding.spec))
        out[name] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name, spec)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", CONFIGS)
def test_input_specs_match_reference(fake_group, arch, mesh_name):
    shape, names = MESHES[mesh_name]
    fake_group(int(np.prod(shape)))
    mesh = make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu")
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape),
                              names)
    model, jmodel = make_model(get_config(arch)), jax_make_model(jax_get_config(arch))
    for shape_name, cell in SHAPES.items():
        table = "DECODE_RULES" if cell.kind == "decode" else "TRAIN_RULES"
        rules = ShardingRules(mesh, dict(DECODE_RULES if cell.kind == "decode" else TRAIN_RULES))
        jrules = JR.ShardingRules(jmesh, dict(getattr(JR, table)))
        got = port_leaves(input_specs(model, cell, rules))
        want = jax_leaves(jax_specs.input_specs(jmodel, JAX_SHAPES[shape_name], jrules))
        assert got == want, (arch, shape_name, mesh_name)


# --------------------------------------------------------------------------- #
# The parser's conventions (tests/test_sharding_and_roofline.py, mirrored)
# --------------------------------------------------------------------------- #
def traced(fn, *shapes):
    inputs = [torch.empty(s, device="meta") for s in shapes]
    return make_fx(fn, tracing_mode="fake")(*inputs), inputs


class TestGraphParser:
    def test_one_product(self):
        gm, inputs = traced(lambda a, w: a @ w.to(torch.float32), (8, 16), (16, 32))
        cost = analyze_graph_module(gm, inputs)
        assert cost.flops == 2 * 8 * 32 * 16

    def test_unrolled_layers_count_each_time(self):
        def stack(x):
            for _ in range(12):
                x = x @ x
            return x

        gm, inputs = traced(stack, (8, 8))
        cost = analyze_graph_module(gm, inputs)
        assert cost.while_trip_counts == []
        assert cost.flops == 12 * 2 * 8 * 8 * 8

    def test_collectives_all_reduce_doubled_reduce_scatter_at_operand(self, fake_group):
        import torch.distributed._functional_collectives as funcol

        fake_group(4)
        group = dist.group.WORLD

        def comm(x):
            a = funcol.all_reduce(x, "sum", group)
            b = funcol.reduce_scatter_tensor(a, "sum", 0, group)
            return funcol.all_gather_tensor(b, 0, group)

        gm, inputs = traced(comm, (1024,))
        cost = analyze_graph_module(gm, inputs)
        # all-reduce: 1024 * 4 * 2; reduce-scatter: its operand, 1024 * 4;
        # all-gather: its output, 1024 * 4.
        assert cost.collective_bytes == 1024 * 4 * 2 + 1024 * 4 + 1024 * 4
        assert cost.collective_count == {"all-reduce": 1, "reduce-scatter": 1, "all-gather": 1}
        assert cost.collective_by_kind["all-reduce"] == 1024 * 4 * 2

    def test_traffic_skips_views_and_charges_in_place_writes_at_update_size(self):
        def write(buf, upd):
            x = buf.view(4, 16)                  # a view: no traffic
            x.narrow(0, 1, 2).copy_(upd)          # 2 x the update's bytes
            return (x * 2.0).sum()                # mul: 2 x 256 B; sum: 2 x 4 B

        gm, inputs = traced(write, (64,), (2, 16))
        cost = analyze_graph_module(gm, inputs)
        upd, out, total = 2 * 16 * 4, 4 * 16 * 4, 4
        # 2x every output (the copy's is the slice it writes), and each
        # op's reads of the graph's inputs: the copy reads the update and
        # its destination slice, the mul the whole buffer through its view.
        assert cost.traffic_bytes == (2 * upd + upd + upd) + (2 * out + out) + 2 * total
        assert cost.memory_stats["argument_bytes"] == 64 * 4 + upd
        assert cost.memory_stats["output_bytes"] == 4

    def test_model_flops_conventions(self):
        assert model_flops("train", 100, 10) == 6000
        assert model_flops("prefill", 100, 10) == 2000
        assert model_flops("decode", 100, 10) == 2000

    def test_h100_constants(self):
        assert HW_H100 == dict(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
                               link_bw=450e9)


# --------------------------------------------------------------------------- #
# run_cells, artifacts, report tables
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_archs():
    """Two configs registered for these tests: smollm-135m reduced (one
    layer, d 64), and one whose block no model code builds (its cell
    fails)."""
    ok = dataclasses.replace(get_config("smollm-135m").reduced(), name="dryrun-test-tiny")
    bad = dataclasses.replace(ok, name="dryrun-test-broken",
                              pattern=(base.BlockDef("conv", None),), num_layers=1)
    for cfg in (ok, bad):
        if cfg.name not in base.all_configs():
            base.register(cfg)
    return ok.name, bad.name


def test_run_cells_records_and_artifacts(tiny_archs, tmp_path):
    ok, bad = tiny_archs
    out = tmp_path / "dryrun"
    recs = dryrun.run_cells([(ok, "prefill_32k"), (ok, "decode_32k"), (ok, "train_4k"),
                             (ok, "long_500k"), (bad, "prefill_32k")],
                            meshes=("pod16x16",), out_dir=str(out))
    status = {(r["arch"], r["shape"]): r["status"] for r in recs}
    assert status == {(ok, "prefill_32k"): "ok", (ok, "decode_32k"): "ok",
                      (ok, "train_4k"): "ok", (ok, "long_500k"): "skipped",
                      (bad, "prefill_32k"): "error"}
    assert not dist.is_initialized()
    by_shape = {r["shape"]: r for r in recs if r["arch"] == ok}
    assert by_shape["long_500k"]["reason"].startswith("long_500k requires sub-quadratic")
    err = next(r for r in recs if r["arch"] == bad)
    assert err["error"].startswith("NotImplementedError") and "traceback" in err
    train = by_shape["train_4k"]
    assert train["kind"] == "train" and train["microbatches"] == 1
    assert train["memory_stats"]["alias_bytes"] > 0
    assert train["model_flops_total"] == 6 * train["active_param_count"] * 256 * 4096
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        rec = by_shape[shape]
        assert REPORT_KEYS | {"status", "wall_s"} == set(rec)
        assert rec["compile_s"] == 0.0 and rec["lower_s"] > 0
        assert rec["memory_stats"]["while_trip_counts"] == []
        assert rec["hw"] == HW_H100 and rec["chips"] == 256
        assert rec["flops_per_chip"] > 0 and rec["coll_bytes_per_chip"] > 0
    files = sorted(p.name for p in out.iterdir())
    assert files == sorted(f"{r['arch']}__{r['shape']}__pod16x16.json" for r in recs)
    on_disk = report.load(str(out))
    assert len(on_disk) == len(recs)

    table = report.dryrun_table(on_disk)
    assert table.count("\n| ") == len(recs)
    assert "| ok |" in table and "SKIP" in table and "**ERROR**" in table
    roof = report.roofline_table(on_disk, "pod16x16")
    assert f"| {ok} | prefill_32k |" in roof and f"| {ok} | decode_32k |" in roof
    assert f"| {ok} | train_4k |" in roof


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_collective_counts_agree_with_comm_debug_mode(tiny_archs, fake_group, shape_name):
    """The parser's collectives, kind by kind, are the ones `CommDebugMode`
    counts when the same cell runs eagerly on the `DTensor`s."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import layers as L
    from repro_torch.sharding.rules import use_rules

    ok, _ = tiny_archs
    model, shape = make_model(get_config(ok)), SHAPES[shape_name]
    fake_group(256)
    _, rules = dryrun._mesh_and_rules(shape.kind, False)
    with use_rules(rules):
        params = model.abstract_params(rules, param_dtype=L.COMPUTE_DTYPE)
        spec = input_specs(model, shape, rules)
        if shape.kind == "prefill":
            fn, args = (lambda p, b: model.prefill(p, b)), (params, spec)
        else:
            fn, args = ((lambda p, i, c: model.decode_step(p, i, c, shape.seq_len - 1)),
                        (params, spec["inputs"], spec["caches"]))
        gm, local = dryrun.trace_per_rank(fn, args, rules)
        cost = analyze_graph_module(gm, local)
        with CommDebugMode() as comm, torch.no_grad():
            fn(*args)
    names = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
    counted = {names[str(op).split(".")[-1]]: n for op, n in comm.get_comm_counts().items()}
    assert cost.collective_count and cost.collective_count == counted


def test_lower_cell_refuses_train_and_a_live_group(tiny_archs, fake_group):
    """A train cell traces now (the whole step: the graph holds the
    backward's products and AdamW's update of every leaf); a live process
    group is still refused."""
    ok, _ = tiny_archs
    rec, gm = dryrun.lower_cell(ok, "train_4k", verbose=False)
    assert rec["kind"] == "train" and rec["flops_per_chip"] > 0 and rec["chips"] == 256
    assert not dist.is_initialized()
    outputs = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    # The new state (each parameter and its two moments, the step) and the
    # three metrics.
    n_params = len(tree.flatten(make_model(get_config(ok)).spec()))
    assert len(outputs) == 3 * n_params + 1 + 3
    fake_group(4)
    with pytest.raises(RuntimeError, match="process group is live"):
        dryrun.lower_cell(ok, "prefill_32k")


def test_named_tuples_round_trip_through_leaves_and_rebuild():
    """The train state is NamedTuples (`TrainState`, `AdamWState`): their
    tensors come out in order and a rebuild gives the same types back,
    fields by name."""
    from repro_torch.train import AdamWState, TrainState

    t = [torch.full((2,), float(i)) for i in range(5)]
    state = TrainState(params={"a": t[0], "b": {"c": t[1]}},
                       opt=AdamWState(step=t[2], m={"a": t[3]}, v=[t[4]]))
    leaves = dryrun._leaves(state, [])
    assert [int(x[0]) for x in leaves] == [0, 1, 2, 3, 4]
    back = dryrun._rebuild(state, iter([x + 10 for x in leaves]))
    assert type(back) is TrainState and type(back.opt) is AdamWState
    assert float(back.params["b"]["c"][0]) == 11 and float(back.opt.step[0]) == 12
    assert isinstance(back.opt.v, list) and float(back.opt.v[0][0]) == 14


def _local_state_bytes(arch: str, moments_dtype: str) -> int:
    """The rank's share of `abstract_train_state`'s bytes on the 16 x 16
    mesh (a fake group of its own)."""
    from repro_torch.train import AdamWConfig, abstract_train_state

    dryrun.start_fake_group(256)
    try:
        _, rules = dryrun._mesh_and_rules("train", False)
        state = abstract_train_state(make_model(get_config(arch)), rules,
                                     opt_cfg=AdamWConfig(moments_dtype=moments_dtype))
        return sum(t.to_local().numel() * t.element_size() if isinstance(t, DTensor)
                   else t.numel() * t.element_size() for t in dryrun._leaves(state, []))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tiny_train_cells(tiny_archs):
    """The tiny config's train_4k cell at the defaults, at 2 microbatches
    and with bf16 moments, and its prefill_32k cell."""
    ok, _ = tiny_archs
    out = {}
    for key, kw in (("default", {}), ("micro2", {"microbatches": 2}),
                    ("bf16", {"moments_dtype": "bfloat16"})):
        out[key], _ = dryrun.lower_cell(ok, "train_4k", verbose=False, **kw)
    out["prefill"], _ = dryrun.lower_cell(ok, "prefill_32k", verbose=False)
    return out


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_alias_bytes_are_the_donated_state(tiny_archs, tiny_train_cells, moments):
    """The reference donates the train state to its step: a train cell's
    ``alias_bytes`` is the rank's share of the state's bytes; a prefill
    cell donates nothing."""
    ok, _ = tiny_archs
    rec = tiny_train_cells["default" if moments == "float32" else "bf16"]
    assert rec["memory_stats"]["alias_bytes"] == _local_state_bytes(ok, moments)
    assert tiny_train_cells["prefill"]["memory_stats"]["alias_bytes"] == 0


def test_microbatches_count_the_same_flops(tiny_train_cells):
    """Two microbatches run the same products on half the rows each: the
    per-chip FLOPs equal one microbatch's. Each microbatch gathers the
    weights and reduces its gradients again, while its activations'
    collectives halve: collective bytes grow by no more than one
    all-reduce of the whole fp32 gradient (2 x 4 bytes a parameter), the
    exchange the reference repeats per microbatch."""
    one, two = tiny_train_cells["default"], tiny_train_cells["micro2"]
    assert two["microbatches"] == 2
    assert two["flops_per_chip"] == one["flops_per_chip"]
    assert two["model_flops_total"] == one["model_flops_total"]
    grow = two["coll_bytes_per_chip"] - one["coll_bytes_per_chip"]
    assert grow <= 2 * 4 * one["param_count"], (grow, one["param_count"])


def test_bf16_moments_halve_the_moments_argument_bytes(tiny_train_cells):
    """``--moments-dtype bfloat16`` stores both moments in 2 bytes: the
    arguments lose half the fp32 moments' bytes (2 x the parameters'), and
    the products are unchanged."""
    f32, bf16 = tiny_train_cells["default"], tiny_train_cells["bf16"]
    params = (f32["memory_stats"]["alias_bytes"] - 4) / 3      # fp32 params, m, v; step
    moments = 2 * params
    assert f32["memory_stats"]["argument_bytes"] - bf16["memory_stats"]["argument_bytes"] \
        == moments / 2
    assert bf16["flops_per_chip"] == f32["flops_per_chip"]


def test_main_writes_the_artifact(tiny_archs, tmp_path):
    ok, _ = tiny_archs
    dryrun.main(["--arch", ok, "--shape", "decode_32k", "--multi-pod", "--out", str(tmp_path)])
    with open(tmp_path / f"{ok}__decode_32k__pod2x16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["mesh"] == "pod2x16x16" and rec["chips"] == 512


# --------------------------------------------------------------------------- #
# One cell against the reference's lower_cell
# --------------------------------------------------------------------------- #
FLOPS_LIMIT = 0.10      # PERF.md §6, written there before the first comparison


def compare_with_reference(shape_name: str) -> tuple[dict, dict]:
    """smollm-135m cut to 2 layers: (the port's record, the reference's
    model FLOPs and per-chip dot FLOPs) for one cell on the 16 x 16 mesh,
    the reference run by tests/dryrun_reference_compare.py's script."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REFERENCE, "smollm-135m", shape_name, "2", "1",
                          "0"], capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2, name="smollm-135m-2l")
    if cfg.name not in base.all_configs():
        base.register(cfg)
    got, _ = dryrun.lower_cell(cfg.name, shape_name, verbose=False)
    return got, want


def test_cell_matches_reference_lower_cell():
    got, want = compare_with_reference("prefill_32k")
    assert got["model_flops_total"] == want["model_flops"]
    assert abs(got["flops_per_chip"] / want["flops"] - 1) <= FLOPS_LIMIT, (
        got["flops_per_chip"], want["flops"])


def test_train_cell_matches_reference_lower_cell():
    """The whole train step (loss, the remat recompute, the backward,
    AdamW) against the reference's jitted step with its state donated: the
    same model FLOPs, per-chip product FLOPs within the limit PERF.md §6
    wrote for the train cells before the comparison (10%; measured equal
    to the last digit), and the donated state's bytes aliased on both
    sides."""
    got, want = compare_with_reference("train_4k")
    assert got["kind"] == "train"
    assert got["model_flops_total"] == want["model_flops"]
    assert abs(got["flops_per_chip"] / want["flops"] - 1) <= FLOPS_LIMIT, (
        got["flops_per_chip"], want["flops"])


def test_decode_32k_matches_the_hand_count():
    check_hand_count("decode")


def test_consecutive_cells_share_no_traced_tensor():
    """Each cell is traced in a fake mode of its own: nothing one trace
    made (the encoder–decoder's position table) may be kept for the next.
    whisper-large-v3 reduced, two cells in a row."""
    cfg = dataclasses.replace(get_config("whisper-large-v3").reduced(), name="dryrun-test-encdec")
    if cfg.name not in base.all_configs():
        base.register(cfg)
    for multi_pod in (False, True):
        rec, _ = dryrun.lower_cell(cfg.name, "decode_32k", multi_pod=multi_pod, verbose=False)
        assert rec["flops_per_chip"] > 0
