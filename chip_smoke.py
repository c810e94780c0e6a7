#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which exits non-zero on a failed check:
  1. the card's name and power limit; build the CUDA kernels from csrc/;
  2. each kernel against its plain PyTorch version on the card, over the
     JAX package's test shapes and the serving path's shapes, and timed
     beside the plain version and a PyTorch library call;
  3. the main path: full-width smollm-135m (random weights from a seed)
     served by `ServeEngine`, 8 prompts of 512 tokens and 4 of 128, 32 new
     tokens each; the kernel launch counts must show that every layer's
     prefill attention went through the kernel;
  4. last-position logits of one prompt prefilled through the kernel
     against the same prompt half prefilled, half decoded token by token
     through plain attention over the cache;
  5. a JSON line of the kernels' numbers, then the result line.

Needs a CUDA device and the repository's src/ beside this file.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 / fp32
# tensor-core FLOP/s, for the least time a kernel could take.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"torch.bfloat16": 989e12, "torch.float32": 495e12}

FLASH_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, dtype): the JAX package's test sweep ...
    (1, 4, 4, 256, 256, 64, True, "float32"),
    (2, 8, 2, 256, 256, 128, True, "float32"),
    (1, 8, 1, 128, 128, 64, True, "float32"),
    (1, 4, 4, 128, 384, 64, False, "float32"),
    (2, 4, 2, 256, 256, 64, True, "bfloat16"),
    (1, 2, 2, 512, 512, 128, True, "bfloat16"),
    (1, 4, 4, 128, 128, 32, False, "float32"),
    # ... causal with Sq != Sk (top-left mask), a ragged length, the reduced
    # configs' head dim, and the serving path's wave shapes.
    (1, 2, 2, 128, 256, 64, True, "float32"),
    (2, 9, 3, 200, 200, 64, True, "bfloat16"),
    (2, 3, 1, 12, 12, 16, True, "bfloat16"),
    (4, 9, 3, 128, 128, 64, True, "bfloat16"),
    (8, 9, 3, 512, 512, 64, True, "bfloat16"),
]
SLICE_SHAPE = (8, 9, 3, 512, 512, 64, True, "bfloat16")
TOL = {"float32": 2e-3, "bfloat16": 2e-2}     # rtol = atol, tests/test_kernels.py
WHOLE_STACK_TOL = 0.15                         # tests/test_archs.py


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Median over `reps` CUDA-event windows of `inner` calls each, in ms."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def flash_inputs(torch, case, seed: int):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) tensors, the layout the
    model hands the kernel."""
    b, hq, hkv, sq, sk, d, _, dtype = case
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def make(h, s):
        return torch.randn((b, s, h, d), generator=g, device="cuda").to(dt).transpose(1, 2)

    return make(hq, sq), make(hkv, sk), make(hkv, sk)


def phase_kernels(torch, fa) -> dict:
    worst = {}
    for i, case in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, case, seed=i)
        causal, dtype = case[6], case[7]
        out = fa.flash_attention_cuda(q, k, v, causal=causal)
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if out.dtype != q.dtype or out.shape != q.shape:
            fail(f"flash {case}: got {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = TOL[dtype]
        ok = bool((err <= tol + tol * ref.float().abs()).all())
        print(f"flash {case}: max|diff| {err.max().item():.3e} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash kernel disagrees with its plain version at {case}")
        worst[case] = err.max().item()

    b, hq, hkv, sq, sk, d, causal, dtype = SLICE_SHAPE
    q, k, v = flash_inputs(torch, SLICE_SHAPE, seed=1)
    elem = q.element_size()
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * elem
    visible = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    flops = 4 * d * visible * b * hq
    bound_ms = max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S[str(q.dtype)]) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= flops / PEAK_FLOPS_S[str(q.dtype)] \
        else "operations"
    # The library yardstick reads k/v expanded to the q heads.
    ke = k.repeat_interleave(hq // hkv, dim=1)
    ve = v.repeat_interleave(hq // hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    library_ms = cuda_ms(torch, lambda: sdpa(q, ke, ve, is_causal=True))
    ms2 = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    print(f"flash at {SLICE_SHAPE}: kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "max_abs_err": worst[SLICE_SHAPE],
        "ms": statistics.median([ms, ms2]),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def phase_serve(torch, np, fa, cfg, model, params) -> int:
    from repro_torch.serve import Request, ServeEngine

    class Engine(ServeEngine):
        """Also counts the non-finite logits of every step, on the card: one
        small reduction per step and no extra sync; read after the run."""
        nonfinite = 0

        def _greedy(self, logits):
            real = logits[:, : self.model.cfg.vocab_size]
            self.nonfinite = self.nonfinite + (~torch.isfinite(real)).sum()
            return super()._greedy(logits)

    rng = np.random.default_rng(0)
    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    warm = Engine(model, params, max_batch=8, device="cuda")
    warm.submit(Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 64), max_new_tokens=2))
    warm.run()

    engine = Engine(model, params, max_batch=8, device="cuda")
    lens = [512] * 8 + [128] * 4
    for i, n in enumerate(lens):
        engine.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                              max_new_tokens=32))
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = fa.launches
    st = engine.stats
    want = cfg.num_layers * st.waves
    print(f"serve: {st.requests} requests in {st.waves} waves, {st.generated_tokens} tokens, "
          f"{st.decode_steps} decode steps, wall {wall:.3f}s")
    print(f"serve: prefill {st.prefill_tokens / st.prefill_s:.1f} tok/s "
          f"({st.prefill_tokens} tokens in {st.prefill_s:.4f}s), decode "
          f"{(st.generated_tokens - st.requests) / st.decode_s:.1f} tok/s "
          f"({st.generated_tokens - st.requests} tokens in {st.decode_s:.4f}s)")
    print(f"serve: flash kernel launches {launched} (want {cfg.num_layers} layers x "
          f"{st.waves} waves = {want})")
    if st.waves != 2 or len(results) != len(lens):
        fail(f"want 2 waves and {len(lens)} results, got {st.waves} and {len(results)}")
    if launched != want:
        fail(f"flash kernel launched {launched} times, want {want}")
    for r in results:
        if len(r.tokens) != 32 or r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: {len(r.tokens)} tokens, ids outside [0, vocab)")
    nonfinite = int(engine.nonfinite)
    if nonfinite:
        fail(f"{nonfinite} non-finite logits during serving")
    return launched


def phase_prefill_vs_decode(torch, np, fa, cfg, model, params) -> None:
    from repro_torch.models import lm as LM

    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32))).cuda()
    before = fa.launches
    full, _ = model.prefill(params, {"inputs": ids})
    if fa.launches - before != cfg.num_layers:
        fail(f"prefill launched the kernel {fa.launches - before} times, "
             f"want {cfg.num_layers}")
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16], max_len=32)
    for t in range(16, 32):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
    v = cfg.vocab_size
    a, b = full[:, :v].float(), logits[:, :v].float()
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool(
        (err <= WHOLE_STACK_TOL + WHOLE_STACK_TOL * b.abs()).all())
    print(f"prefill-through-kernel vs token-by-token decode: max|diff| "
          f"{err.max().item():.3e} (tol {WHOLE_STACK_TOL}), argmax "
          f"{int(a.argmax())} vs {int(b.argmax())}")
    if not ok:
        fail("prefill through the kernel disagrees with plain decode over the cache")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if torch.cuda.device_count() != 1:
        fail(f"{torch.cuda.device_count()} GPUs visible; this smoke run drives one "
             f"(set CUDA_VISIBLE_DEVICES to one card)")
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import make_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    fa._library()
    print(f"build: flash_attention in {time.perf_counter() - t0:.1f}s")
    ptxas = os.path.join(ROOT, "build", "flash_attention.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as f:
            for line in f:
                if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                    print("ptxas:", line.strip())

    kernel = phase_kernels(torch, fa)

    cfg = get_config("smollm-135m")
    model = make_model(cfg)
    params = model.init(0, device="cuda")
    kernel["launches"] = phase_serve(torch, np, fa, cfg, model, params)
    phase_prefill_vs_decode(torch, np, fa, cfg, model, params)

    for key, val in kernel.items():
        if isinstance(val, float) and not math.isfinite(val):
            fail(f"kernel number {key} is not finite")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
