"""Serving driver: weights published to an object store and restored from
it through Rolling Prefetch (cold-start latency is a first-order cost at
serving scale, and checkpoint restore is exactly the sequential
multi-object stream the paper optimizes), then batched prefill + greedy or
sampled decode with decode caches (attention KV caches, Mamba conv/SSM
states, an encoder-decoder's cross caches), on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --full \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --full \
      --batch 8 --prompt-len 1500 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b --full \
      --quant int8 --batch 8 --prompt-len 512 --gen 32

For an encoder-decoder, --prompt-len is the encoder's frame count (stub
frame embeddings) and the decoder's prompt is 8 tokens. --quant int8
quantizes the restored weights to int8 with fp32 scales (weight-only,
`models/quant.py`); each product dequantizes its weight first.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt.manager import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.io import IOPolicy, open_store
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models.quant import quantize_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> np.ndarray:
    """Run the driver; returns the generated token ids, (batch, gen)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--restore-mode", default="rolling",
                    choices=["rolling", "sequential"])
    ap.add_argument("--autotune", action="store_true",
                    help="adaptive restore: coalesced range GETs + AIMD "
                         "stream depth + closed-loop blocksize tuning")
    ap.add_argument("--store", default="sims3://weights?latency_ms=10&bw_mbps=80",
                    help="weight store URI (any registered scheme)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent weight-block cache directory: restores "
                         "cache into a journaled DirTier there, so a "
                         "restarted replica cold-starts warm (zero store "
                         "GETs for blocks that survived on local disk)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="weight-only int8 serving: int8 weights, fp32 scales")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg)
    device = torch.device(args.device)

    # --- publish + cold-start restore through the object store ----------------
    store = open_store(args.store)
    params = model.init(args.seed, device=device)
    save_checkpoint(store, "weights", 0, params,
                    policy=IOPolicy(write_depth=4))
    # The restore reads only the template's structure, so it gets `meta`
    # stand-ins and the initialised tree is freed first: the card then holds
    # one copy of the weights, not two (codeqwen1.5-7b's fp32 tree is
    # 32.8 GB of an H100's 80).
    template = tree.map_leaves(lambda t: torch.empty_like(t, device="meta"), params)
    del params
    t0 = time.perf_counter()
    params, _ = restore_checkpoint(
        store, "weights", template,
        policy=IOPolicy(engine=args.restore_mode, depth=2,
                        max_depth=8 if args.autotune else None,
                        autotune=args.autotune,
                        eviction_interval_s=0.2),
        cache_dir=args.cache_dir,
        device=device,
    )
    print(f"weight restore ({args.restore_mode}): {time.perf_counter() - t0:.2f}s"
          + (f" [cache: {args.cache_dir}]" if args.cache_dir else ""))
    if args.quant == "int8":
        params, n_q = quantize_params(params)
        print(f"quantized {n_q} weight tensors to int8 (weight-only)")

    # --- batched prefill -------------------------------------------------------
    b, s = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)

    def frames() -> torch.Tensor:
        return torch.from_numpy(
            rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        ).to(device, torch.bfloat16)

    if cfg.is_encdec:
        enc_inputs = frames()
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 8))).to(device)
    elif cfg.embed_inputs:
        inputs = frames()
    else:
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(device)

    # Decode needs cache headroom for generated tokens.
    prompt_tokens = inputs.shape[1]
    max_len = prompt_tokens + args.gen
    _sync(device)
    t0 = time.perf_counter()
    if cfg.is_encdec:
        # Encoder over the frames, its per-layer cross caches, then the
        # decoder prompt through the stack with its caches.
        logits, caches = ED.encdec_prefill(params, cfg, enc_inputs, inputs,
                                           max_len=max_len, q_chunk=min(512, s))
    else:
        caches = LM.make_stack_cache(cfg, b, max_len, device=device)
        h, caches, _ = LM.lm_hidden(params, cfg, inputs, caches=caches, update_cache=True,
                                    q_chunk=min(512, s), last=True)
        logits = LM.logits_from_hidden(params, cfg, h)[:, 0]
    _sync(device)
    dt = time.perf_counter() - t0
    if cfg.is_encdec:
        print(f"prefill: {dt:.3f}s ({b * s / dt:.0f} frames/s encoded, "
              f"{b} prompts of {prompt_tokens} tokens)")
    else:
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
        if cfg.embed_inputs and not cfg.is_encdec:
            # VLM decode consumes token embeddings from the text table.
            step_in = params["embed"]["table"][tok[:, 0]][:, None, :].to(torch.bfloat16)
        else:
            step_in = tok
        logits, caches = model.decode_step(params, step_in, caches, prompt_tokens + i)
        tok = pick(logits)
        generated.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    out = torch.cat(generated, dim=1).cpu().numpy()
    print(f"decoded {args.gen} tokens x {b} seqs in {dt:.3f}s "
          f"({b * args.gen / dt:.1f} tok/s)")
    print("sample token ids:", out[0, :16])
    return out


if __name__ == "__main__":
    main()
