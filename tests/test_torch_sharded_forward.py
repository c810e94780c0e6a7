"""The port's sharded forward (the model code's `constrain` calls,
head-sharded attention, DTensor-safe tables, masks and cache writes)
against its unsharded forward and against the JAX package's layout calls,
on the CPU.

One gloo world of 8 spawned ranks (tests/test_torch_sharded_worker.py) runs
the attention-only configs, reduced, on a (4, 2) ("data", "model") mesh
under each rules table, in fp32 activations: the loss, every leaf's
gradient, a prefill and two decode steps must equal the same calls with no
mesh within 1e-4 (|a - b| <= 1e-4 * (1 + |b|)). The same world calls the
kernels' entries on DTensors: whole layouts go through `local_map` and
equal the plain version, the training entry's gradients included; a
sequence-sharded layout raises; and one train step of reduced
granite-moe-3b-a800m equals the step with no mesh. The MoE and Mamba
configs run in tests/test_torch_sharded_forward_mixers.py, a world of
their own.

In this process: head-mode `_attn_core` against the reference's on one
rank, in fp32 and bf16, and the entries' ``meta`` route. The layout calls,
call for call against the reference's, are in
tests/test_torch_constrain_calls.py.
"""

from __future__ import annotations

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
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.models.layers as jax_L
from repro.sharding import rules as jax_rules
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.dryrun import start_fake_group
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import layers as L
from repro_torch.models.spec import abstract_tensor
from repro_torch.sharding import rules as port_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_sharded_worker.py")
ATTENTION_CONFIGS = ["codeqwen1.5-7b", "command-r-plus-104b", "llava-next-mistral-7b",
                     "olmo-1b", "smollm-135m", "whisper-large-v3"]
TABLES = ["TRAIN_RULES", "DECODE_RULES", "DECODE_TP_RULES"]
TOL = 1e-4
QUANTITIES = ("loss", "grads", "prefill", "decode")


def run_world(tmp_path_factory, names: list[str], *extra: str) -> dict:
    """The worker's 8 gloo ranks over `names`; its JSON results."""
    out = tmp_path_factory.mktemp("sharded") / "results.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, WORKER, str(out), *extra, *names],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    return run_world(tmp_path_factory, ATTENTION_CONFIGS, "--ops")


def check_world(results: dict, arch: str, table: str) -> None:
    got = results[arch][table]
    assert got["n_grads"] > 0
    for q in QUANTITIES:
        abs_diff, rel_diff = got[q]
        assert rel_diff <= TOL, (arch, table, q, abs_diff, rel_diff)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ATTENTION_CONFIGS)
def test_sharded_forward_equals_unsharded(gloo_world, arch, table):
    check_world(gloo_world, arch, table)


def test_decode_rules_equal_train_rules():
    """The worker runs DECODE_RULES once with TRAIN_RULES: they are equal
    entry for entry (only their names differ in the reference too)."""
    assert port_rules.DECODE_RULES == port_rules.TRAIN_RULES


@pytest.mark.parametrize("name", ["replicated", "batch_heads"])
@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_ops_whole_layouts_run_on_local_shards(gloo_world, kernel, name):
    """Whole (batch, head) layouts go through `local_map` to the plain
    version on each rank's shard: the logical result equals the plain
    version on the logical inputs, laid out as the first input."""
    err, placements = gloo_world["ops"][f"{kernel}_{name}"]
    assert err == 0.0
    if name == "replicated":
        assert placements == ["R", "R"]
    else:
        assert placements == ["S(0)", "S(1)" if kernel == "flash" else "S(2)"]


@pytest.mark.parametrize("name", ["batch_heads", "kv_replicated"])
def test_train_entry_on_split_heads_carries_gradients(gloo_world, name):
    """`ops.flash_attention_train` under autograd with q's heads split on
    ``model`` (and the batch on ``data``), k/v split alike or, of one kv
    head, replicated (their gradient a partial sum across the head ranks):
    the output keeps q's layout, and the output and the q, k and v
    gradients equal the plain tensors' within 1e-5 (the partial sums add in
    another order)."""
    got = gloo_world["ops"][f"train_{name}"]
    assert got["rel"] <= 1e-5
    assert got["placements"] == ["S(0)", "S(1)"]
    assert got["grads"] == [True, True, True]


@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_ops_refuse_a_sequence_sharded_layout(gloo_world, kernel):
    assert gloo_world["ops"][f"{kernel}_seq"].startswith("ValueError: ")
    assert "sequence-sharded" in gloo_world["ops"][f"{kernel}_seq"]


def test_split_batch_keeps_the_layout(gloo_world):
    """`train_step._split_batch` of a batch split on ``data`` (16 rows over
    4 ranks): each microbatch keeps the batch's placements, holds 8 rows,
    and equals the plain split of every rank's own rows (rank r's i-th
    half), taken in rank order."""
    got = gloo_world["ops"]["split_batch"]
    assert got["placements"] == [["S(0)", "R"], ["S(0)", "R"]]
    assert got["shapes"] == [[8, 3], [8, 3]]
    assert got["equal"] == [True, True]


def test_train_step_equals_unsharded(gloo_world):
    """One `build_train_step` step of reduced granite-moe-3b-a800m on the
    mesh under TRAIN_RULES against the step with no mesh: the metrics,
    every moment and every update within the world's limit, and the
    expert weights' partial-sum gradients laid out as their parameters
    before the optimizer reads them (`train_step._laid_out_as`)."""
    got = gloo_world["train_step"]
    assert got["n"] > 0 and got["relaid"] > 0, got
    assert got["diff"][1] <= TOL, got


def check_training_scan(results: dict, arch: str, table: str) -> None:
    """The sharded loss and gradients ran the training scan on local
    shards only (through `local_map`), forward and remat recompute."""
    calls = results[arch][table]["scan_calls"]
    assert calls["DTensor"] == 0 and calls["local"] > 0, calls


# --------------------------------------------------------------------------- #
# In this process
# --------------------------------------------------------------------------- #
@pytest.fixture
def fake_group():
    """`start(world)`: this process as rank 0 of a ``fake`` group;
    destroyed at teardown."""
    def start(world: int) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        start_fake_group(world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_ops_meta_route_is_the_plain_version(fake_group):
    """A ``meta`` tensor (the dry-run's) takes the plain version: shapes
    out, no launch, nothing allocated. A DTensor over ``meta`` shards laid
    out whole goes through `local_map` to it on each rank's shard; one
    split on a sequence dim raises, as any DTensor does."""
    before = (fa.launches, ssd.launches)
    q = torch.empty(2, 4, 64, 16, device="meta")
    k = torch.empty(2, 2, 64, 16, device="meta")
    out = ops.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape
    fake_group(8)
    mesh = make_mesh_compat((4, 2), ("data", "model"), device_type="cpu")
    from repro_torch.sharding.rules import NamedSharding

    def meta(shape, dtype, *placements):
        return abstract_tensor(shape, dtype, NamedSharding(mesh, placements))

    qd = meta((8, 4, 64, 16), torch.bfloat16, Shard(0), Shard(1))
    kd = meta((8, 2, 64, 16), torch.bfloat16, Shard(0), Replicate())
    out = ops.flash_attention(qd, kd, kd)
    assert isinstance(out, DTensor) and out.to_local().device.type == "meta"
    assert tuple(out.shape) == (8, 4, 64, 16) and out.placements == (Shard(0), Shard(1))
    assert tuple(out.to_local().shape) == (2, 2, 64, 16)
    with pytest.raises(ValueError, match="sequence-sharded"):
        ops.flash_attention(qd, meta((8, 2, 64, 16), torch.bfloat16, Shard(0), Shard(2)),
                            kd)
    x = meta((8, 64, 4, 16), torch.bfloat16, Shard(0), Shard(2))
    a = meta((8, 64, 4), torch.float32, Shard(0), Shard(2))
    bc = meta((8, 64, 1, 16), torch.bfloat16, Shard(0), Replicate())
    y, state = ops.ssd_scan(x, a, bc, bc, chunk=32)
    assert tuple(y.shape) == (8, 64, 4, 16) and tuple(state.shape) == (8, 4, 16, 16)
    assert y.placements == (Shard(0), Shard(2)) and state.placements == (Shard(0), Shard(1))
    assert (fa.launches, ssd.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_mode_attn_core_matches_reference(dtype):
    """`_attn_core` in head mode (k/v expanded to the q heads, laid out on
    ``heads``; the context in v's dtype) against the reference's, on one
    rank whose ``heads`` resolves: GQA 8 q heads over 2 kv heads, causal,
    two query chunks, a query offset. Both sides record a ``heads`` layout
    call, so both took head mode."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((2, 64, 8, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    seen = {"ref": [], "port": []}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    real_jax = jax_rules.constrain

    def jax_spy(x, *axes):
        seen["ref"].append(axes)
        return real_jax(x, *axes)

    orig = jax_L.constrain
    jax_L.constrain = jax_spy
    try:
        with jax_rules.use_rules(jax_rules.ShardingRules(jmesh, dict(jax_rules.TRAIN_RULES))):
            want = jax_L._attn_core(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                    causal=True, q_offset=0, q_chunk=32)
    finally:
        jax_L.constrain = orig
    want = np.asarray(want.astype(jnp.float32))

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh_compat((1, 1), ("data", "model"), device_type="cpu")
        real_port = port_rules.constrain

        def port_spy(x, *axes):
            seen["port"].append(axes)
            return real_port(x, *axes)

        orig = L.constrain
        L.constrain = port_spy
        try:
            with port_rules.use_rules(port_rules.ShardingRules(mesh, dict(port_rules.TRAIN_RULES))):
                got = L._attn_core(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   causal=True, q_offset=0, q_chunk=32)
        finally:
            L.constrain = orig
        got = got.full_tensor() if isinstance(got, DTensor) else got
    finally:
        dist.destroy_process_group()
    # The reference traces its chunk loop (a scan) once; the port runs both
    # chunks: k, v, then each chunk's queries and scores.
    assert seen["port"] == seen["ref"][:2] + seen["ref"][2:] * 2
    assert seen["ref"][0] == ("batch", None, "heads", None)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_training_scan_on_meta_runs_rank_by_rank(fake_group):
    """The training scan (`models.ssd._differentiable_scan`, `ssd_chunked`
    under autograd) on `DTensor`s over ``meta`` shards of a ``fake``
    16 x 16 group, traced with its backward as the dry-run traces a train
    cell: no op makes a strided shard, and one rank's products are those of
    the plain scan and its backward at that rank's (batch, head) slices."""
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.overrides import TorchFunctionMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.launch.dryrun import trace_per_rank
    from repro_torch.models import ssd as S
    from repro_torch.roofline.graph_parse import analyze_graph_module
    from repro_torch.sharding.rules import NamedSharding

    fake_group(256)
    mesh = make_mesh_compat((16, 16), ("data", "model"), device_type="cpu")
    rules = port_rules.ShardingRules(mesh, dict(port_rules.TRAIN_RULES))
    batch, seq, heads, p, n, chunk = 32, 512, 64, 32, 64, 128

    def meta(shape, *placements):
        return abstract_tensor(shape, torch.float32, NamedSharding(mesh, placements))

    args = (meta((batch, seq, heads, p), Shard(0), Shard(2)),
            meta((batch, seq, heads), Shard(0), Shard(2)),
            meta((batch, seq, 1, n), Shard(0), Replicate()),
            meta((batch, seq, 1, n), Shard(0), Replicate()))

    def step(*inputs):
        live = [t.detach().requires_grad_(True) for t in inputs]
        with torch.enable_grad():
            y, state = S._differentiable_scan(*live, chunk, None)
            return torch.autograd.grad(y.sum() + state.sum(), live)

    strided = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            strided.extend(t for t in torch.utils._pytree.tree_leaves(out)
                           if isinstance(t, DTensor)
                           and any(isinstance(pl, _StridedShard) for pl in t.placements))
            return out

    def spied(*inputs):
        with Spy():
            return step(*inputs)

    gm, local = trace_per_rank(spied, args, rules)
    assert strided == []
    assert [tuple(t.shape) for t in local] == [(2, seq, 4, p), (2, seq, 4), (2, seq, 1, n),
                                               (2, seq, 1, n)]
    plain = make_fx(step, tracing_mode="fake")(*[torch.empty(t.shape, device="meta")
                                                 for t in local])
    want = analyze_graph_module(plain, [torch.empty(t.shape, device="meta") for t in local])
    assert want.flops > 0
    assert analyze_graph_module(gm, local).flops == want.flops
