"""Checkpoint restore onto the card: leaves through the pinned staging ring
and the side stream arrive bit-exact, and an engine cold-started from the
store serves the tokens of one built on the same weights in memory.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_restore.py
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch.ckpt import manager
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.io import IOPolicy, open_store
from repro_torch.models import make_model
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda

_bucket = itertools.count()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: restore onto the card has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tree(device, dtype):
    """Reduced smollm-135m weights, plus a 0-d and an empty leaf."""
    params = make_model(get_config("smollm-135m").reduced()).init(0, device=device,
                                                                  param_dtype=dtype)
    return {"params": params, "step": torch.tensor(7, dtype=torch.int32, device=device),
            "empty": torch.empty((0, 3), dtype=dtype, device=device)}


def _leaves(tree):
    return manager._flatten(tree)


@pytest.mark.parametrize("engine", ["rolling", "sequential"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_restore_onto_the_card_is_bit_exact(cuda, monkeypatch, dtype, engine):
    # Staging buffers far smaller than most leaves: leaves cross in pieces,
    # and both slots are reused many times.
    monkeypatch.setattr(manager, "STAGING_BYTES", 3000)
    tree = _tree(cuda, dtype)
    store = open_store(f"sims3://card{next(_bucket)}?latency_ms=0")
    save_checkpoint(store, "ckpt", 1, tree)
    template = {"params": tree["params"], "step": tree["step"].to("meta"),
                "empty": tree["empty"].to("meta")}
    restored, _ = restore_checkpoint(store, "ckpt", template, device="cuda",
                                     policy=IOPolicy(engine=engine, blocksize=8 << 10,
                                                     eviction_interval_s=0.01))
    for want, got in zip(_leaves(tree), _leaves(restored)):
        assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
        assert got.data_ptr() != want.data_ptr() or want.numel() == 0


def test_engine_from_store_serves_the_in_memory_tokens(cuda):
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    params = model.init(0, device=cuda)
    store = open_store(f"sims3://card{next(_bucket)}?latency_ms=0")
    save_checkpoint(store, "weights", 0, params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (16, 16, 24)]

    def serve(engine):
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        return {r.rid: r.tokens.tolist() for r in engine.run()}

    cold = ServeEngine.from_store(model, store, "weights", params, device="cuda")
    assert all(t.is_cuda for t in _leaves(cold.params))
    assert serve(cold) == serve(ServeEngine(model, params, device="cuda"))
