"""The kernels' route on a mesh, on the card: flash attention and the SSD
scan called with `DTensor`s on a one-rank NCCL mesh go through `local_map`
to the CUDA kernels (one launch each) and match their plain versions; a
split over one rank counts as whole. Training on the mesh: the scan that
needs gradients runs `ssd_chunked` through `local_map` (no launch) with
the plain path's values and gradients, the kernel's entry still refuses a
`DTensor` that needs grad, the flash training kernels take `DTensor`s that
need grad through `local_map`, and a reduced olmo-1b train step through the
`DTensor` path equals the plain step at 1 and 2 microbatches.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharded.py
"""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.mesh import make_debug_mesh

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}      # tests/test_kernels.py


@pytest.fixture
def nccl():
    """A one-rank NCCL group on the card, destroyed at teardown."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    yield dev
    dist.destroy_process_group()


def place(t, mesh, *placements):
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["batch_heads", "replicated"])
def test_flash_through_local_map(nccl, dtype, layout):
    """olmo-1b's serving wave (8, 16, 512, 128), causal."""
    mesh = make_debug_mesh(1, 1)
    gen = torch.Generator(device=nccl).manual_seed(0)
    q, k, v = (torch.randn(8, 16, 512, 128, device=nccl, generator=gen).to(dtype)
               for _ in range(3))
    pl = (Shard(0), Shard(1)) if layout == "batch_heads" else (Replicate(), Replicate())
    before = fa.launches
    with torch.no_grad():
        out = ops.flash_attention(*(place(t, mesh, *pl) for t in (q, k, v)), causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert isinstance(out, DTensor) and out.placements == pl
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.full_tensor(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_through_local_map(nccl, dtype):
    """mamba2-1.3b's widths (64 heads of 64, state 128, chunk 256), a
    512-token prompt of batch 2, with an initial state."""
    mesh = make_debug_mesh(1, 1)
    gen = torch.Generator(device=nccl).manual_seed(1)
    x = (torch.randn(2, 512, 64, 64, device=nccl, generator=gen) * 0.1).to(dtype)
    dt_a = -torch.rand(2, 512, 64, device=nccl, generator=gen) * 0.1
    b, c = ((torch.randn(2, 512, 1, 128, device=nccl, generator=gen) * 0.1).to(dtype)
            for _ in range(2))
    init = torch.randn(2, 64, 64, 128, device=nccl, generator=gen) * 0.1
    before = ssd.launches
    with torch.no_grad():
        y, h = ops.ssd_scan(place(x, mesh, Shard(0), Shard(2)), place(dt_a, mesh, Shard(0), Shard(2)),
                            place(b, mesh, Shard(0), Replicate()),
                            place(c, mesh, Shard(0), Replicate()), chunk=256,
                            initial_state=place(init, mesh, Shard(0), Shard(1)))
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    want_y, want_h = ssd.ssd_scan_plain(x, dt_a, b, c, chunk=256, initial_state=init)
    torch.testing.assert_close(y.full_tensor().float(), want_y.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(h.full_tensor(), want_h, rtol=TOL[dtype], atol=TOL[dtype])


def test_a_split_over_one_rank_counts_as_whole(nccl):
    """On one rank every split is over one rank, so every layout is whole:
    a `Shard` of the sequence over a mesh dim of size 1 reaches the kernel."""
    mesh = make_debug_mesh(1, 1)
    q = torch.randn(2, 4, 128, 64, device=nccl, dtype=torch.bfloat16)
    before = fa.launches
    with torch.no_grad():
        out = ops.flash_attention(place(q, mesh, Shard(0), Shard(2)),
                                  place(q, mesh, Shard(0), Shard(2)),
                                  place(q, mesh, Shard(0), Shard(2)))
    assert fa.launches == before + 1 and out.shape == q.shape


def test_training_flash_through_local_map(nccl):
    """`ops.flash_attention_train` on bf16 `DTensor`s that need grad (olmo-1b's
    heads, batch 2 of 512, split on batch and heads): one forward and one
    backward launch through `local_map`, the output and the gradients of
    q, k and v bit for bit those of the plain tensors through the kernels."""
    mesh = make_debug_mesh(1, 1)
    gen = torch.Generator(device=nccl).manual_seed(4)
    q, k, v, dout = (torch.randn(2, 16, 512, 128, device=nccl, generator=gen).bfloat16()
                     for _ in range(4))
    pl = (Shard(0), Shard(1))

    def run(inputs, grad):
        live = [t.detach().requires_grad_(True) for t in inputs]
        out = ops.flash_attention_train(*live)
        out.backward(grad)
        full = [out] + [t.grad for t in live]
        return [t.full_tensor() if isinstance(t, DTensor) else t for t in full]

    before = (fa.launches, fa.backward_launches)
    got = run([place(t, mesh, *pl) for t in (q, k, v)], place(dout, mesh, *pl))
    assert (fa.launches, fa.backward_launches) == (before[0] + 1, before[1] + 1)
    want = run([q, k, v], dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_training_scan_through_local_map(nccl):
    """`models.ssd._differentiable_scan` on `DTensor`s that need grad (fp32,
    mamba2-1.3b's head and state widths, batch 2 of 512): `ssd_chunked` on
    the local shards, no kernel launch, y, the final state and the
    gradients of every input equal to the plain path's on the card."""
    from repro_torch.models import ssd as S

    mesh = make_debug_mesh(1, 1)
    gen = torch.Generator(device=nccl).manual_seed(2)
    x = torch.randn(2, 512, 64, 64, device=nccl, generator=gen) * 0.1
    dt_a = -torch.rand(2, 512, 64, device=nccl, generator=gen) * 0.1
    b, c = (torch.randn(2, 512, 1, 128, device=nccl, generator=gen) * 0.1 for _ in range(2))
    layout = [(Shard(0), Shard(2)), (Shard(0), Shard(2)), (Shard(0), Replicate()),
              (Shard(0), Replicate())]

    def run(inputs):
        live = [t.detach().requires_grad_(True) for t in inputs]
        y, h = S._differentiable_scan(*live, 256, None)
        full = [t.full_tensor() if isinstance(t, DTensor) else t for t in (y, h)]
        grads = torch.autograd.grad(y.sum() + (h * h).sum(), live)
        return full + [g.full_tensor() if isinstance(g, DTensor) else g for g in grads]

    before = ssd.launches
    got = run([place(t, mesh, *pl) for t, pl in zip((x, dt_a, b, c), layout)])
    want = run([x, dt_a, b, c])
    torch.cuda.synchronize()
    assert ssd.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL[torch.float32], atol=TOL[torch.float32])


def test_entry_refuses_a_dtensor_that_needs_grad(nccl):
    """No fallback: `ops.ssd_scan` on a CUDA `DTensor` that needs grad goes
    through `local_map` to the kernel's entry, which refuses it."""
    mesh = make_debug_mesh(1, 1)
    x = torch.randn(1, 256, 4, 64, device=nccl, requires_grad=True)
    dt_a = -torch.rand(1, 256, 4, device=nccl)
    b = torch.randn(1, 256, 1, 64, device=nccl)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.ssd_scan(place(x, mesh, Shard(0), Shard(2)), place(dt_a, mesh, Shard(0), Shard(2)),
                     place(b, mesh, Shard(0), Replicate()), place(b, mesh, Shard(0), Replicate()),
                     chunk=256)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_dtensor_equals_plain(nccl, microbatches):
    """A reduced olmo-1b `build_train_step` step (fp32 activations, remat)
    laid out by TRAIN_RULES on the one-rank mesh against the plain step
    from the same weights: the metrics, every moment and every update."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.ft.elastic import reshard_params
    from repro_torch.models import layers as L
    from repro_torch.models import make_model
    from repro_torch.sharding.rules import TRAIN_RULES, ShardingRules, use_rules
    from repro_torch.train import AdamWConfig, StepConfig, TrainState, build_train_step, init_state

    model = make_model(get_config("olmo-1b").reduced())
    params = model.init(0, device=nccl)
    ids = torch.randint(0, model.cfg.vocab_size, (2 * microbatches, 65), device=nccl,
                        generator=torch.Generator(device=nccl).manual_seed(3))
    rules = ShardingRules(make_debug_mesh(1, 1), dict(TRAIN_RULES))

    def step(rules):
        p = params if rules is None else reshard_params(params, model.spec(), rules)
        batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:]}
        if rules is not None:
            batch = {k: place(v, rules.mesh, Shard(0), Replicate()) for k, v in batch.items()}
        with use_rules(rules):
            new, metrics = build_train_step(model, AdamWConfig(), StepConfig(
                microbatches=microbatches))(TrainState(p, init_state(p)), batch)

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        return ([full(v) for v in metrics.values()]
                + [full(a) - full(b) for a, b in zip(tree.flatten(new.params), tree.flatten(p))]
                + [full(t) for t in tree.flatten(new.opt)])

    L.COMPUTE_DTYPE = torch.float32
    try:
        got, want = step(rules), step(None)
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
