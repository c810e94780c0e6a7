"""The port's mesh tooling on the card: a one-rank NCCL `DeviceMesh`, a
sharded save and a resharded restore on it, and the flash kernel at
olmo-1b's serving wave against its plain version.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.ft.elastic import reshard_params, restore_resharded, snapshot_resharded
from repro_torch.io import open_store
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_debug_mesh, mesh_host_shard
from repro_torch.models import make_model
from repro_torch.models.spec import ParamSpec, param_shardings
from repro_torch.sharding.rules import DECODE_TP_RULES, TRAIN_RULES, ShardingRules

pytestmark = pytest.mark.cuda

_bucket = itertools.count()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA kernel have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def nccl(cuda):
    """A one-rank NCCL group on the card, destroyed at teardown."""
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda)
    yield cuda
    dist.destroy_process_group()


def test_one_rank_nccl_mesh(nccl):
    mesh = make_debug_mesh(1, 1)
    assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
    assert mesh_host_shard() == (0, 1)
    x = torch.arange(12.0, device=nccl).reshape(3, 4)
    placed = reshard_params({"w": x}, {"w": ParamSpec((3, 4), ("fsdp", "tp"))},
                            ShardingRules(mesh))
    assert placed["w"].to_local().is_cuda
    assert torch.equal(placed["w"].full_tensor(), x)


def test_save_and_resharded_restore_on_the_card(nccl):
    """Reduced olmo-1b placed by TRAIN_RULES on a 1 x 1 CUDA mesh, saved,
    restored onto a DECODE_TP_RULES template: the template's placements,
    bit-equal logical arrays on the card, objects equal to a plain save's,
    and a post-reshard snapshot at step 1."""
    model = make_model(get_config("olmo-1b").reduced())
    spec = model.spec()
    mesh = make_debug_mesh(1, 1)
    params = model.init(0, device=nccl)
    placed = reshard_params(params, spec, ShardingRules(mesh, dict(TRAIN_RULES)))
    store = open_store(f"sims3://mesh{next(_bucket)}?latency_ms=0")
    save_checkpoint(store, "m", 0, placed)
    plain = open_store(f"sims3://mesh{next(_bucket)}?latency_ms=0")
    save_checkpoint(plain, "m", 0, params)
    for meta in plain.list_objects("m/step_00000000/"):
        if not meta.key.endswith("MANIFEST.json"):
            assert store.get(meta.key) == plain.get(meta.key), meta.key

    rules = ShardingRules(mesh, dict(DECODE_TP_RULES))
    template = model.abstract_params(rules)
    restored, _ = restore_resharded(store, "m", template, host_id=0, num_hosts=1,
                                    device=nccl)
    for a, b, t in zip(tree.flatten(params), tree.flatten(restored), tree.flatten(template)):
        assert b.placements == t.placements and b.to_local().is_cuda
        assert torch.equal(b.full_tensor(), a)
    snapshot_resharded(store, "m", 1, restored, param_shardings(spec, rules))
    assert latest_step(store, "m") == 1
    again, _ = restore_checkpoint(store, "m", params, device=nccl)
    for a, b in zip(tree.flatten(params), tree.flatten(again)):
        assert torch.equal(a, b)


def test_flash_at_olmos_wave(cuda):
    """(8, 16, 512, 128) causal bf16, MHA: the D = 128 kernel against its
    plain version."""
    rng = np.random.default_rng(0)

    def make():
        x = rng.standard_normal((8, 512, 16, 128), dtype=np.float32)
        return torch.from_numpy(x).to(cuda, torch.bfloat16).transpose(1, 2)

    q, k, v = make(), make(), make()
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    ref = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 5e-3
