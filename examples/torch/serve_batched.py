"""Batched serving end-to-end on the GPU (the PyTorch counterpart of
examples/serve_batched.py): publish weights to the object store, restore
through Rolling Prefetch (the paper's stream, applied to cold-start),
quantize them to int8, then drain a request queue through the wave-batched
serving engine.

  PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.io import IOPolicy, open_store
from repro_torch.models import make_model
from repro_torch.models.quant import quantize_params
from repro_torch.serve import Request, ServeEngine


def main(argv: list[str] | None = None) -> list:
    """Serve the example's queue; returns the engine's results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to run on the host)")

    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)

    # --- cold start: weights stream from the object store --------------------
    store = open_store("sims3://weights?latency_ms=10&bw_mbps=80", fresh=True)
    params = model.init(0, device=device)
    save_checkpoint(store, "weights", 0, params, policy=IOPolicy(write_depth=4))
    template = tree.map_leaves(lambda t: torch.empty_like(t, device="meta"), params)
    del params
    t0 = time.perf_counter()
    params, _ = restore_checkpoint(
        store, "weights", template,
        policy=IOPolicy(engine="rolling", depth=4, eviction_interval_s=0.2),
        device=device,
    )
    print(f"cold-start restore (rolling prefetch, depth 4): "
          f"{time.perf_counter() - t0:.2f}s")

    # --- weight-only int8 (beyond-paper serving memory/collective lever) ------
    params, n_q = quantize_params(params)
    print(f"int8-quantized {n_q} weight tensors")

    # --- request queue: mixed prompt lengths, mixed budgets -------------------
    rng = np.random.default_rng(0)
    engine = ServeEngine(model, params, max_batch=4, device=device)
    for rid in range(10):
        n = int(rng.choice([8, 8, 8, 16]))
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 10)),
        ))

    results = engine.run()
    s = engine.stats
    print(f"served {s.requests} requests in {s.waves} waves "
          f"({s.generated_tokens} tokens, {s.tokens_per_s():.1f} tok/s, "
          f"{s.decode_steps} decode steps) on {device}")
    for r in results[:3]:
        print(f"  rid={r.rid} prompt_len={r.prompt_len} "
              f"generated={len(r.tokens)} first_ids={r.tokens[:5]}")
    if len(results) != 10:
        raise RuntimeError(f"served {len(results)} requests, want 10")
    print("OK")
    return results


if __name__ == "__main__":
    main()
