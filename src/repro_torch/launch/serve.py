"""Serving driver: batched prefill + greedy or sampled decode with decode
caches (attention KV caches, Mamba conv/SSM states), on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --full \
      --batch 8 --prompt-len 512 --gen 32

Weights come from the port's own seeded init. Restoring them from an
object store (the JAX driver's --store/--restore-mode/--autotune/
--cache-dir) and --quant int8 arrive in later slices of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm as LM
from repro_torch.models import make_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg)
    device = torch.device(args.device)
    print("weights: seeded init (--seed); restore from an object store "
          "arrives in a later slice of the port")
    params = model.init(args.seed, device=device)

    # --- batched prefill -------------------------------------------------------
    b, s = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    if cfg.embed_inputs:
        inputs = torch.from_numpy(
            rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        ).to(device, torch.bfloat16)
    else:
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(device)

    # Decode needs cache headroom for generated tokens.
    caches = LM.make_stack_cache(cfg, b, s + args.gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    h, caches = LM.lm_hidden(params, cfg, inputs, caches=caches, update_cache=True,
                             q_chunk=min(512, s))
    logits = LM.logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0]
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"prefill: {dt:.3f}s ({b * s / dt:.0f} tok/s)")

    # --- decode loop -----------------------------------------------------------
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        logits = logits[:, : cfg.vocab_size]
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)
        return logits.argmax(dim=-1, keepdim=True)

    tok = pick(logits)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        if cfg.embed_inputs:
            # VLM decode consumes token embeddings from the text table.
            step_in = params["embed"]["table"][tok[:, 0]][:, None, :].to(torch.bfloat16)
        else:
            step_in = tok
        logits, caches = model.decode_step(params, step_in, caches, s + i)
        tok = pick(logits)
        generated.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    out = torch.cat(generated, dim=1).cpu().numpy()
    print(f"decoded {args.gen} tokens x {b} seqs in {dt:.3f}s "
          f"({b * args.gen / dt:.1f} tok/s)")
    print("sample token ids:", out[0, :16])


if __name__ == "__main__":
    main()
