"""The vocab-sharded embedding lookup, the kv_seq mode's P·V split over
an idle mesh axis and the Mamba decode step's state read, on 8 gloo ranks,
against the same calls on whole tensors.

One world of 8 spawned CPU processes (this file run as a script) builds a
(4, 2) ("data", "model") mesh and a (2, 2, 2) ("pod", "data", "model")
mesh, the production meshes' two layouts. On each:

- `layers._sharded_lookup` of a padded table (1000 ids in 1024 rows, so
  the last 24 rows are the padding) laid out as the rules lay out
  ``("tp", "fsdp")``: ids at every row-shard boundary, in the padded rows
  and repeated, split on ``batch`` (a decode step's) and whole (batch 1,
  long_500k's). The output, and the same output laid out as `lm_hidden`'s
  ``("batch", None, "residual")``, must equal ``table[ids]`` bit for bit;
  the table's gradient must equal the scatter-add of the output gradient
  into the rows the ids name (1e-6). `layers._lookup` must pick the
  sharded lookup for a decode step's ids and the lookup by columns (the
  table relaid by one all-to-all) for a prompt of more tokens; both must
  equal ``table[ids]``, and their gradients the scatter-add (1e-6, and
  1e-5 where the ranks' partial gradients of 4096 ids are summed).
- `layers._lookup` of a table whose d (odd) does not split over the
  model axis's ranks: a prompt's ids looked up in place, no all-to-all.
- `ssd._read_state`, the Mamba decode step's ``y = C h``, on a state split
  on batch and heads and on batch and N (a partial sum): within 1e-5 of
  the einsum on whole tensors.
- `layers._plus_bias`: a partial sum split on the model axis plus a bias
  split there along its heads, reduced into the bias's split (heads),
  within 1e-5 of the whole sum.
- `layers._pv_split_over_idle_axes`, the kv_seq mode's P·V product with
  its operands split on the cache's positions only (batch 1: the data
  axis, and the pod axis, split nothing): it must split the product over
  those axes' ranks by heads (counted) and equal ``pm @ vt`` within 1e-5,
  for GQA groups of 4 and 2 and chunks of 1 and 2 query rows; and
  `layers._attn_core` at batch 1 against a cache on ``kv_seq``, a valid
  length short of the cache, must equal the unsharded call within 1e-5.
- `sharding.rules.relaid`, a split moved from the model axis to the data
  axis and back by one all-to-all (a one-token residual's d), and from a
  projection's columns to its sequence and back on the model axis (k and
  v for the kv_seq mode), the batch split on the data axis: the values
  bit for bit, the gradient too, and the layout asked for.
- reduced mamba2-1.3b, jamba-1.5-large-398b and granite-moe-3b-a800m at a
  batch of 1 (the data axis idle: the residual's d moved onto it, the
  context reduce-scattered onto its merged heads, MoE rows gathered before
  dispatch) in fp32, laid out by DECODE_RULES: the loss, every gradient,
  a prefill and two decode steps within 1e-4 of the unsharded calls
  (relative: the limit of tests/test_torch_sharded_forward.py's world).

  PYTHONPATH=src python tests/test_torch_sharded_lookup.py OUT.json
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import layers as L
from repro_torch.models import ssd
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import DECODE_RULES, ShardingRules, relaid, use_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 8
MESHES = {"pod16x16-like": ((4, 2), ("data", "model")),
          "pod2x16x16-like": ((2, 2, 2), ("pod", "data", "model"))}
VOCAB, ROWS, D = 1000, 1024, 16
JOIN_TIMEOUT_S = 300
ATTN_CASES = {"g4": (2, 4), "g2": (4, 2)}     # (kv heads, group)
RELAID_AXES = ["model_to_data", "data_to_model"]
RELAID_DIMS = ["columns_to_sequence", "sequence_to_columns"]
RELAID_WAYS = RELAID_AXES + RELAID_DIMS
BATCH_1_ARCHS = ["granite-moe-3b-a800m", "jamba-1.5-large-398b", "mamba2-1.3b"]


# --------------------------------------------------------------------------- #
# The world (run as a script)
# --------------------------------------------------------------------------- #
def _ids(batch: int) -> torch.Tensor:
    """(batch, 8) ids: both sides of every row-shard boundary of the
    model axis (2 ranks: 512) and of 8 row blocks, padded rows (1000 ..
    1023), repeats, and random ids."""
    rng = np.random.default_rng(batch)
    fixed = [0, 511, 512, 1023, 1000, 999, 511, 511, 127, 128, 255, 256, 767, 768, 895, 896]
    ids = np.concatenate([fixed, rng.integers(0, ROWS, batch * 8)])[:batch * 8]
    return torch.from_numpy(ids.reshape(batch, 8))


def _lookup_checks(mesh, rules: ShardingRules) -> dict:
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((ROWS, D), dtype=np.float32))
    out = {}
    for name, batch in (("batch_split", 8), ("batch_1", 1)):
        ids = _ids(batch)
        grad_out = torch.from_numpy(rng.standard_normal((batch, 8, D), dtype=np.float32))
        want = table[ids]
        want_grad = torch.zeros_like(table).index_add_(0, ids.reshape(-1),
                                                       grad_out.reshape(-1, D))
        t = distribute_tensor(table, mesh, rules.sharding(("tp", "fsdp"), (ROWS, D)).placements,
                              src_data_rank=None).requires_grad_()
        i = distribute_tensor(ids, mesh, rules.sharding(("batch", None), tuple(ids.shape))
                              .placements, src_data_rank=None)
        with use_rules(rules):
            got = L._sharded_lookup(t, i)
            laid = L.constrain(got, "batch", None, "residual")
        whole = got.full_tensor()
        (whole * grad_out).sum().backward()
        out[f"lookup_{name}"] = float((whole.detach() - want).abs().max())
        out[f"lookup_{name}_laid_out"] = float((laid.full_tensor() - want).abs().max())
        out[f"lookup_{name}_grad"] = float((t.grad.full_tensor() - want_grad).abs().max())
        out[f"lookup_{name}_table_placements"] = str(t.placements)

    # `_lookup` chooses by bytes: a decode step's ids look up in place; a
    # prompt of 64 x 64 ids (more bytes than a column slice of the table)
    # by columns, the table relaid with one all-to-all; the same prompt in
    # place where d (odd) does not split over the model axis's ranks.
    odd = torch.from_numpy(rng.standard_normal((ROWS, D - 1), dtype=np.float32))
    for name, ids, tab in (("decode", _ids(8), table),
                           ("prompt", torch.from_numpy(rng.integers(0, ROWS, (64, 64))), table),
                           ("prompt_odd_d", torch.from_numpy(rng.integers(0, ROWS, (64, 64))),
                            odd)):
        d = tab.shape[1]
        grad_out = torch.from_numpy(rng.standard_normal((*ids.shape, d), dtype=np.float32))
        t = distribute_tensor(tab, mesh, rules.sharding(("tp", "fsdp"), (ROWS, d)).placements,
                              src_data_rank=None).requires_grad_()
        i = distribute_tensor(ids, mesh, rules.sharding(("batch", None), tuple(ids.shape))
                              .placements, src_data_rank=None)
        calls, swaps = [], []
        sharded, swap = L._sharded_lookup, R._dims_swapped
        L._sharded_lookup = lambda *a: calls.append(1) or sharded(*a)
        R._dims_swapped = lambda *a: swaps.append(1) or swap(*a)
        try:
            with use_rules(rules):
                got = L.constrain(L._lookup(t, i), "batch", None, "residual")
        finally:
            L._sharded_lookup, R._dims_swapped = sharded, swap
        whole = got.full_tensor()
        (whole * grad_out).sum().backward()
        want_grad = torch.zeros_like(tab).index_add_(0, ids.reshape(-1), grad_out.reshape(-1, d))
        out[f"choose_{name}"] = float((whole.detach() - tab[ids]).abs().max())
        out[f"choose_{name}_grad"] = float((t.grad.full_tensor() - want_grad).abs().max())
        out[f"choose_{name}_sharded"] = len(calls)
        out[f"choose_{name}_swaps"] = len(swaps)
    return out


def _attn_checks(mesh, rules: ShardingRules) -> dict:
    out = {}
    rng = np.random.default_rng(1)
    sk, dh, valid = 64, 8, 50
    model = [p for p in range(mesh.ndim) if mesh.mesh_dim_names[p] == "model"][0]

    def on_model(t, dim):
        placements = [Shard(dim) if m == model else Replicate() for m in range(mesh.ndim)]
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    for name, (hkv, g) in ATTN_CASES.items():
        # The product alone, its operands split on the cache's positions
        # only, for one query row and for a chunk of two.
        for c in (1, 2):
            pm = torch.from_numpy(rng.random((1, hkv, c * g, sk), dtype=np.float32))
            vt = torch.from_numpy(rng.standard_normal((1, hkv, sk, dh), dtype=np.float32))
            split = []
            local_map = L.local_map
            L.local_map = lambda *a, **kw_: split.append(1) or local_map(*a, **kw_)
            try:
                got = L._pv_split_over_idle_axes(on_model(pm, 3), on_model(vt, 2), g)
            finally:
                L.local_map = local_map
            out[f"pv_{name}_c{c}"] = float((got.full_tensor() - pm @ vt).abs().max())
            out[f"pv_{name}_c{c}_split"] = len(split)
        # The whole kv_seq-mode attention at batch 1 against its cache.
        q = torch.from_numpy(rng.standard_normal((1, 1, hkv * g, dh), dtype=np.float32))
        k = torch.from_numpy(rng.standard_normal((1, sk, hkv, dh), dtype=np.float32))
        v = torch.from_numpy(rng.standard_normal((1, sk, hkv, dh), dtype=np.float32))
        kw = dict(causal=True, q_offset=valid - 1, kv_valid_len=valid, q_chunk=1,
                  head_mode=False)
        want = L._attn_core(q, k, v, **kw)
        with use_rules(rules):
            cache = rules.sharding(("batch", "kv_seq", None, None), tuple(k.shape))
            kd = distribute_tensor(k, mesh, cache.placements, src_data_rank=None)
            vd = distribute_tensor(v, mesh, cache.placements, src_data_rank=None)
            got = L._attn_core(L.constrain(q, "batch", None, None, None), kd, vd, **kw)
        out[f"attn_{name}"] = float((got.full_tensor() - want).abs().max())
    return out


def _state_checks(mesh) -> dict:
    """`ssd._read_state` (the decode step's ``y = C h``) on a state split
    on batch and heads, and on batch and N (a partial sum), against the
    einsum on whole tensors."""
    rng = np.random.default_rng(2)
    state = torch.from_numpy(rng.standard_normal((4, 4, 3, 8), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((4, 4, 8), dtype=np.float32))
    want = torch.einsum("bhpn,bhn->bhp", state, c)
    out = {}
    for name, dims in (("heads", (0, 1)), ("n", (0, 3))):
        lead = [Shard(dims[0])] * (mesh.ndim - 1)
        st = distribute_tensor(state, mesh, lead + [Shard(dims[1])], src_data_rank=None)
        cd = distribute_tensor(c, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
        got = ssd._read_state(st, cd)
        out[f"state_{name}"] = float((got.full_tensor() - want).abs().max())
        out[f"state_{name}_placements"] = str(got.placements)
    return out


def _bias_checks(mesh) -> dict:
    """`layers._plus_bias` on a partial sum (a projection whose contraction
    is split on the model axis) and a bias split along its heads there:
    the sum reduced into the bias's split, equal to the whole sum."""
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.standard_normal((mesh.size(mesh.ndim - 1), 4, 3, 4, 5),
                                                 dtype=np.float32))
    bias = torch.from_numpy(rng.standard_normal((4, 5), dtype=np.float32))
    model = mesh.get_coordinate()[-1]
    lead = [Replicate()] * (mesh.ndim - 1)
    y = DTensor.from_local(parts[model], mesh, lead + [Partial()], run_check=False)
    b = distribute_tensor(bias, mesh, lead + [Shard(0)], src_data_rank=None)
    got = L._plus_bias(y, b)
    return {"bias": float((got.full_tensor() - (parts.sum(0) + bias)).abs().max()),
            "bias_placements": str(got.placements)}


def _relaid_checks(mesh) -> dict:
    """`relaid` of (4, 8, 48) split on its last dim from the model axis to
    the data axis and back, and on the model axis from its last dim to its
    second and back (its batch on the data axis), against the whole tensor
    and its gradient."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 8, 48), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 8, 48), dtype=np.float32))
    names = list(mesh.mesh_dim_names)
    axes = {"model": [Shard(2) if n == "model" else Replicate() for n in names],
            "data": [Shard(2) if n == "data" else Replicate() for n in names],
            "columns": [Shard(2) if n == "model" else Shard(0) if n == "data" else Replicate()
                        for n in names],
            "sequence": [Shard(1) if n == "model" else Shard(0) if n == "data" else Replicate()
                         for n in names]}
    out = {}
    for name in RELAID_WAYS:
        src, dst = name.split("_to_")
        xd = distribute_tensor(x, mesh, axes[src], src_data_rank=None).requires_grad_()
        swaps, swap = [], R._dims_swapped
        R._dims_swapped = lambda *a: swaps.append(1) or swap(*a)
        try:
            got = relaid(xd, axes[dst])
        finally:
            R._dims_swapped = swap
        (got.full_tensor() * g).sum().backward()
        out[f"relaid_{name}"] = float((got.full_tensor().detach() - x).abs().max())
        out[f"relaid_{name}_grad"] = float((xd.grad.full_tensor() - g).abs().max())
        out[f"relaid_{name}_placements"] = got.placements == tuple(axes[dst])
        out[f"relaid_{name}_swaps"] = len(swaps)
    return out


def _batch_1_model_checks(mesh) -> dict:
    """Reduced configs at a batch of 1 on DECODE_RULES against no mesh:
    the largest relative difference of the loss, the gradients, the
    prefill and the decode steps."""
    from test_torch_sharded_worker import diff, forward, inputs, make_model, reshard_params

    L.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for arch in BATCH_1_ARCHS:
            cfg = get_config(arch).reduced()
            model = make_model(cfg)
            params = model.init(0, device="cpu")
            data = {k: v[:1] for k, v in inputs(cfg).items()}
            want = forward(model, params, data, None)
            rules = ShardingRules(mesh, dict(DECODE_RULES))
            got = forward(model, reshard_params(params, model.spec(), rules), data, rules)
            out[f"batch_1_{arch}"] = max(
                [diff(got[k], want[k])[1] for k in ("loss", "prefill", "decode")]
                + [diff(a, b)[1] for a, b in zip(got["grads"], want["grads"])])
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    return out


def run() -> dict:
    results = {}
    for mesh_name, (shape, names) in MESHES.items():
        mesh = make_mesh_compat(shape, names, device_type="cpu")
        rules = ShardingRules(mesh, dict(DECODE_RULES))
        results[mesh_name] = {**_lookup_checks(mesh, rules), **_attn_checks(mesh, rules),
                              **_state_checks(mesh), **_bias_checks(mesh),
                              **_relaid_checks(mesh), **_batch_1_model_checks(mesh)}
    return results


def rank_main(rank: int, workdir: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=RANKS)
    try:
        results = run()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=rank_main, args=(r, workdir, argv[0])) for r in range(RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"FAIL: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


# --------------------------------------------------------------------------- #
# The tests
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("lookup") / "results.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", ["batch_split", "batch_1"])
def test_sharded_lookup_equals_whole_table(world, mesh, batch):
    got = world[mesh]
    assert "Shard" in got[f"lookup_{batch}_table_placements"]
    assert got[f"lookup_{batch}"] == 0.0
    assert got[f"lookup_{batch}_laid_out"] == 0.0
    assert got[f"lookup_{batch}_grad"] <= 1e-6


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_lookup_weighs_the_bytes(world, mesh):
    got = world[mesh]
    assert got["choose_decode"] == 0.0 and got["choose_decode_sharded"] == 1
    assert got["choose_decode_swaps"] == 0
    assert got["choose_prompt"] == 0.0 and got["choose_prompt_sharded"] == 0
    assert got["choose_prompt_swaps"] == 1
    assert got["choose_decode_grad"] <= 1e-6 and got["choose_prompt_grad"] <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_lookup_in_place_where_d_does_not_split(world, mesh):
    got = world[mesh]
    assert got["choose_prompt_odd_d"] == 0.0 and got["choose_prompt_odd_d_sharded"] == 1
    assert got["choose_prompt_odd_d_swaps"] == 0
    assert got["choose_prompt_odd_d_grad"] <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("split", ["heads", "n"])
def test_decode_state_read_equals_einsum(world, mesh, split):
    got = world[mesh]
    assert got[f"state_{split}"] <= 1e-5
    assert ("Partial" in got[f"state_{split}_placements"]) == (split == "n")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_partial_sum_plus_split_bias(world, mesh):
    got = world[mesh]
    assert got["bias"] <= 1e-5
    assert got["bias_placements"].endswith("Shard(dim=2))")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("rows", [1, 2])
def test_pv_split_over_idle_axes(world, mesh, case, rows):
    got = world[mesh]
    assert got[f"pv_{case}_c{rows}_split"] == 1
    assert got[f"pv_{case}_c{rows}"] <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_batch_1_attention_equals_unsharded(world, mesh, case):
    assert world[mesh][f"attn_{case}"] <= 1e-5



@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("way", RELAID_AXES)
def test_relaid_moves_a_split_between_axes(world, mesh, way):
    got = world[mesh]
    assert got[f"relaid_{way}"] == 0.0 and got[f"relaid_{way}_grad"] == 0.0
    assert got[f"relaid_{way}_placements"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("way", RELAID_DIMS)
def test_relaid_swaps_a_split_between_dims(world, mesh, way):
    got = world[mesh]
    assert got[f"relaid_{way}"] == 0.0 and got[f"relaid_{way}_grad"] == 0.0
    assert got[f"relaid_{way}_placements"] and got[f"relaid_{way}_swaps"] == 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", BATCH_1_ARCHS)
def test_batch_1_model_equals_unsharded(world, mesh, arch):
    assert world[mesh][f"batch_1_{arch}"] <= 1e-4


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
